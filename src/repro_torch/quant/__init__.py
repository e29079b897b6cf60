"""Offline model quantization; port of ``repro/quant/``."""
