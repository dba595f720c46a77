"""PyTorch/CUDA port of the xview2_tpu package (eval path first)."""
