"""Offline preprocessing of the port (a copy of part of
``mhim_mil_tpu/preprocess``): so far the feature-store writer."""
