"""Scripts that measure the port on a card; not imported by the package."""
