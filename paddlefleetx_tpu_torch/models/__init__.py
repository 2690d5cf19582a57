"""Model families of the PyTorch port (GPT so far)."""
