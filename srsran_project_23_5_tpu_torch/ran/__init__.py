"""Static 3GPP configuration math, re-hosted from ``srsran_project_23_5_tpu.ran``
so that the port loads nothing of the JAX package (tests hold each function
equal to its original)."""
