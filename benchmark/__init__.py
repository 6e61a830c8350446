"""The benchmark of gesture_diffusion_torch on an NVIDIA H100 (see
README.md): one command runs one cell once."""
