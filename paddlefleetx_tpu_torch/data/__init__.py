"""Data layer of the PyTorch port: the GPT token datasets, their index
maps (C++ helpers built at first use, numpy plain versions), the index
cache, the batch sampler and loaders, and the config builders."""
