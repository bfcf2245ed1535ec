"""Scene compilation of the port: host builders and the flat level."""
