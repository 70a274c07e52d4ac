"""Entry point: ``python -m mpi_openmp_cuda_tpu_torch < input.txt``."""

from .io.cli import main

if __name__ == "__main__":
    main()
