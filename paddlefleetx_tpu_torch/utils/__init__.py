"""Config, logging and device helpers of the PyTorch port."""
