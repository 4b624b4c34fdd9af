"""repro_torch.launch — command-line entry points (training, serving)."""
