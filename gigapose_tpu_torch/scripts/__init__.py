"""Command-line scripts of the port: template rendering, refiner training and
the BOP benchmark run."""
