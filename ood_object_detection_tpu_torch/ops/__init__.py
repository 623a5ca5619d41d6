"""Box math, post-processing and the hand-written CUDA kernels (K1 NMS in
``cuda_nms``, K2 key + energy reduce in ``cuda_reduce``)."""
