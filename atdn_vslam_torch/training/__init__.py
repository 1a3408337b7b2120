"""Training of the map network (MappingVAE) and its losses."""
