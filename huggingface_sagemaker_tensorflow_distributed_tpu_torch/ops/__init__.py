"""Attention and fused vocab cross-entropy ops of the PyTorch port, and
the build of its CUDA kernels."""
