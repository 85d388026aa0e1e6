# The port's kernel measurement mode: kernel launches on the card fitted
# into the Digital Twin's MeasuredStepTimes (kernels_bench.py).
