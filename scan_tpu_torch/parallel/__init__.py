"""Data parallelism over processes (counterpart of ``scan_tpu/parallel``)."""
