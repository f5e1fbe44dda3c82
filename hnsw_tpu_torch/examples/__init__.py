"""Examples of the PyTorch/CUDA port, each run as
``python -m hnsw_tpu_torch.examples.<name> [--device cuda|cpu]``:
``random_demo``, ``levenshtein_words`` and ``annbench``."""
