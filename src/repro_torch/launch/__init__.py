"""repro_torch.launch — command-line entry points (training, serving) and
the device meshes they train on (``mesh``)."""
