"""The timing protocol and the BENCH document schema of the port (the
parts of ``repro/bench`` the serve launcher needs)."""
