"""Field arithmetic, limb staging, engines and schedulers (PyTorch port)."""
