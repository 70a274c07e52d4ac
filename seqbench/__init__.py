"""The benchmark of the PyTorch and CUDA port (``mpi_openmp_cuda_tpu_torch``):
one cell once is ``python3 -m seqbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``; ``BENCHMARK.json`` at the checkout's root
names the cells, configurations, traffic mixes and metrics."""
