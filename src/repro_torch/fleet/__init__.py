"""Frame pools shared by paged engines (port of repro.fleet's pool; the
fleet manager is not ported yet)."""
