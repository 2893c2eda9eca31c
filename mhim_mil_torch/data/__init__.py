"""Host-side data: the synthetic fixtures, CSV splits, feature-store readers
and length-bucketed batching (copies of ``mhim_mil_tpu/data``)."""
