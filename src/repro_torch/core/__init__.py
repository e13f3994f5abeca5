"""Solver core of the port: preprocessing, projections, the packed
engine, the serial solve and the scikit-learn-style front end."""
