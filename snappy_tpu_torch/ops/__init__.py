"""Block codecs: the plain torch versions, the CUDA kernels and their build,
routing, and the raw-stream host driver."""
