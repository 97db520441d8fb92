"""Model configurations of the assigned architectures (:mod:`.config`)."""
