"""Scripts for the card: kernel tuning sweeps (run as modules, never
imported by the package itself)."""
