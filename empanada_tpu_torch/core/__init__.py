"""Host array and RLE layer of the 3D path (counterpart of
``empanada_tpu/core``): run extraction and connected components over runs,
the flat instance form, RLE and range algebra, and the native library's
bindings (``native.py``)."""
