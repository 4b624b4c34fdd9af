"""The plain reference: the benchmark's configurations written out in
float32 PyTorch operations (:mod:`.model`) and AdamW (:mod:`.adamw`),
independent of the program. It imports nothing of the program, takes the
benchmark's own weights and inputs, and reads the program's outputs only
to judge them."""
