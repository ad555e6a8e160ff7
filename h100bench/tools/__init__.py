"""Tools around the benchmark: calibration runs and planted faults; no
run of ``run.py`` uses them."""
