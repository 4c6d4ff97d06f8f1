"""ropebwt3_tpu_torch — the PyTorch / CUDA port of ropebwt3_tpu.

The port runs `mem` (SMEM finding) on an NVIDIA Hopper card: the fused occ
rows live on the device as a torch tensor and a hand-written CUDA kernel
(csrc/smem_tg.cu) runs the SMEM-TG state machine, one thread per read.
Everything else — index formats, the dense host index, the native host
engines and the CLI's BED writer — is imported from the JAX-free host layer
of `ropebwt3_tpu`, never copied.  This package never imports jax.

Every function takes its device explicitly; nothing here picks one.
"""

__version__ = "0.1.0"
