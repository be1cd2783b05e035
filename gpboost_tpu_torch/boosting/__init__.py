"""Tree boosting of the PyTorch port (GBDT core and the GPBoost algorithm)."""
