"""Pipeline workers of the port: init -> grid -> spotless or klean."""
