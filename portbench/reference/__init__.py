"""Plain PyTorch references of the benchmark's configurations.  They import
nothing of the program (``repro_torch``) and take nothing it made."""
