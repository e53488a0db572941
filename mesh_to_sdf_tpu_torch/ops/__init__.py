"""Grid-path operators of the PyTorch port."""
