"""Durable SQLite tier and the resident engine facade."""
