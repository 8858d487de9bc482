"""One reader a metric: ``metrics/<name>.py`` defines ``read(ctx)``, which
returns the metric's value from the run (``harness.context``), or None
where the run has nothing to read it from."""
