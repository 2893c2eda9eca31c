"""Offline preprocessing of the port (layer L0, a copy of
``mhim_mil_tpu/preprocess``): the slide readers (``tiff``: pyramidal and
tiled TIFF, BigTIFF, Aperio ``.svs``, flat rasters and ``open_slide``, which
routes by extension and by content; ``ndpi``, ``vms``, ``mirax`` and
``vendor_tiff``: Hamamatsu, MIRAX, Philips, Leica and Ventana; their LZW and
PackBits tiles decode in C through ``mhim_mil_torch.native``), tissue
segmentation and the patch grid (``segment``), the patch encoders
(``encoders``), the encoder sweep and the feature-store writer
(``extract``)."""
