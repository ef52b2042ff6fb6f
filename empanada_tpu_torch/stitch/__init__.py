"""Host stitching layer (counterpart of ``empanada_tpu/stitch``): per-slice
instance records, cross-slice matching, 3D tracking, filters, the
ortho-plane and tile consensus, and the tiler."""
