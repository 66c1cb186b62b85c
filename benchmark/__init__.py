"""The benchmark of ``geomloss_tpu_torch`` (see ``README.md``)."""
