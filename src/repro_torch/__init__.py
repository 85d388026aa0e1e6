"""PyTorch/CUDA port of the multi-adapter serving path (see ROADMAP.md)."""
