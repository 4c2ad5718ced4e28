"""Launch layer: mesh enumeration, the sharding rule policy and the
shardings on device meshes (``mesh``), the measurement artifact
(``measure``) and the training launcher (``train``)."""
