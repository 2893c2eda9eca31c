"""Offline preprocessing of the port (layer L0, a copy of part of
``mhim_mil_tpu/preprocess``): tissue segmentation and the patch grid
(``segment``), flat-raster slides (``slide``), the patch encoders
(``encoders``), the encoder sweep and the feature-store writer
(``extract``)."""
