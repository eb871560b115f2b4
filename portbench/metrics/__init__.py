"""One reader a metric, found by the metric's name: ``<name>.py`` defines
``read(run) -> float | None`` over a `portbench.run.Run`.  A reader that finds
nothing to read returns None, and the metric is left out of the line."""
