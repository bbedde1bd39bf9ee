"""quiver_tpu_torch.ops.kernels."""
