"""quiver_tpu_torch.sampling."""
