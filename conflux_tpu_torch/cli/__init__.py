"""Command-line miniapps of the port."""
