"""Host stitching layer of the 3D path (counterpart of
``empanada_tpu/stitch``): per-slice instance records, cross-slice matching,
3D tracking and filters."""
