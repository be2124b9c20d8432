"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``dfr_scan`` (the fused masking + reservoir scan) and ``ridge_gram`` (the
batched readout Gram) replace the JAX package's two Pallas TPU kernels;
``block_copy`` replaces the Pallas fixture of its contract checker's tests;
``readout_apply`` (the fitted readout on bf16 or f32 state chunks, without
an f32 copy of the features) and ``dfr_scan_grad`` (K1ᵀ, the adjoint of
the scan, the LM mixer's gradient) replace no TPU kernel.
Each ``ops.py`` wrapper launches its CUDA kernel (``csrc/*.cu``, built by
``_build.py`` at first use) for CUDA tensors, takes the plain PyTorch
version for CPU tensors, and counts its launches and, on either route, its
calls (``_calls.py``).
"""
