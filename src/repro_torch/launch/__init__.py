"""Launch layer: mesh enumeration and the sharding rule policy."""
