"""obs subpackage of mpi_openmp_cuda_tpu_torch."""
