"""GPT config, parameters and the sampling transforms."""
