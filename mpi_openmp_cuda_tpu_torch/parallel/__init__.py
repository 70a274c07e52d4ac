"""Several devices: batch sharding, the Seq1 ring and multi-process jobs
over ``torch.distributed`` (the port of ``mpi_openmp_cuda_tpu/parallel/``)."""
