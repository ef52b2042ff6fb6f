"""Volume slicing for the 3D path (counterpart of ``empanada_tpu/data``)."""
