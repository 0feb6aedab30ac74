"""PyTorch/CUDA port of nerftex_tpu for NVIDIA Hopper (H100).

Layout mirrors nerftex_tpu/: utils (config runtime), models (encodings and
ParamNerf), ops (volume compositing, rays, proxies), instancing (host scene
compiler and the per-ray/per-sample instancer), render (renderers and
weight transplant) and kernels (hand-written CUDA kernels with their plain
PyTorch versions).  The package imports torch, numpy and PIL only.

Entry points run on "cuda" unless the caller passes device="cpu".
"""
