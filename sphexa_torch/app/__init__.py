"""Command-line front end of the port."""
