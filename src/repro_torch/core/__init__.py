"""Workload generation for the port (a copy of part of repro.core.workload)."""
