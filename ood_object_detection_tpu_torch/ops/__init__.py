"""Box math, labeling, losses, post-processing and the hand-written CUDA
kernels: K1 NMS (``cuda_nms``), K2 key + energy reduce (``cuda_reduce``),
K3 anchor match and K4 target encode (``cuda_labeler``)."""
