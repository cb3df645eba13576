"""The plain reference that decides ``correct``: plain PyTorch, float32
with TF32 off, no kernel, grid, graph or cache, and nothing imported from
the program under test."""
