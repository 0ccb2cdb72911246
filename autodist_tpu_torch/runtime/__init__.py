"""Runtime of the port: cluster bring-up, device resolution, session."""
