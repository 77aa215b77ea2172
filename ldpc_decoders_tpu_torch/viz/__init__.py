"""Analysis of simulation results: ensemble averages."""
