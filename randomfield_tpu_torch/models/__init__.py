"""Physical models: background cosmology and linear power spectra."""
