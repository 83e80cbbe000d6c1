"""The benchmark of the PyTorch and CUDA port (`repro_torch`): the cells
of `BENCHMARK.json` at the checkout's root, run one at a time by
`perfbench/run.py`."""
