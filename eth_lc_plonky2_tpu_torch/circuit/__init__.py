"""Circuit front end of the port: gates, builder, witness (host-only numpy)."""
