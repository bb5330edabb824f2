"""Observability: counters, gauges, histograms, spans and correlation
ids."""
