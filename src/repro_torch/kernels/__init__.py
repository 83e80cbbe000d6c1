"""The kernels of the port and their plain versions.

  slda_gibbs      — kernel B2: one supervised training sweep (CUDA, sm_90a)
  slda_train      — kernel B3: all training sweeps of one fused launch
  slda_predict    — kernel B1: all prediction sweeps in one launch
  sparse          — kernel B4: the sparse two-stage draw of B1–B3 (plain
                    version, index build, and the device function alone)
  flash_attention — kernel B5: causal GQA attention, online softmax
  ssd_scan        — kernel B6: the Mamba-2 SSD chunked scan
  rmsnorm         — kernel B7: RMSNorm with a weight per chain
  ref             — the plain PyTorch versions (the CPU route)
  ops             — the device routing the core and the models call
  build           — nvcc build at first use, ctypes binding

Importing this package builds nothing; the first CUDA launch does.
"""
