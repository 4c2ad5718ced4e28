"""Memory autopilot: only the telemetry ingest of ``watch`` so far."""
