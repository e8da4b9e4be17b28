"""Process-group setup and data-parallel reductions for the port."""
