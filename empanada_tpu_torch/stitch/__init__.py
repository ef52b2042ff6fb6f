"""Host stitching layer (counterpart of ``empanada_tpu/stitch``): per-slice
instance records, cross-slice matching, 3D tracking, filters, the
ortho-plane and tile consensus, the tiler, and the BC watershed."""
