"""Synthetic program corpus, fusion, tile enumeration and sparse packing."""
