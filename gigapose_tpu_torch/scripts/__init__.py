"""Command-line scripts of the port: template rendering and the BOP benchmark run."""
