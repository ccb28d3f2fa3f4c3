"""Hardware constants of the port."""
