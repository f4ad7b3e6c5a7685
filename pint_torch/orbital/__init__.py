"""Orbital mechanics of the port: Keplerian orbits with their Jacobians
(:mod:`pint_torch.orbital.kepler`)."""
