"""Diagnostics: the BSDF sample/pdf visualizer (``bsdf_vis``)."""
