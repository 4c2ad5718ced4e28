"""One reader per metric, found by the metric's name: ``read(ctx)``
returns the metric's value, or None where the run has nothing for it to
read (the harness then leaves the metric out of the line)."""
