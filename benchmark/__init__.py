"""The benchmark of graph_pde_tpu_torch (``run.py`` runs one cell)."""
