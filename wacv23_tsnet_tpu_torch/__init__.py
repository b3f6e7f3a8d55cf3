"""TS-Net in PyTorch for NVIDIA Hopper: the port of `wacv23_tsnet_tpu`.

Face whole-clip inference (`models.tsnet_forward_clip`) and label-driven
serving sessions (`infer.RetargetSession`) at the full width of
`configs.face_config()`. The TPU package's Pallas kernels on this path
are hand-written CUDA kernels under `csrc/`, built with nvcc at first use
(`ops.cuda_build`). Public functions keep the JAX package's NHWC layout.
Entry points run on the GPU unless the caller passes `device="cpu"`.
"""
