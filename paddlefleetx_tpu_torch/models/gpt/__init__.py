"""GPT decoder-only LM: config, parameters, weight bridge, generation."""
