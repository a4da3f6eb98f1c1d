"""Command-line launchers over the service API."""
