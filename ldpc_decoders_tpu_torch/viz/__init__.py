"""Analysis of simulation results: ensemble averages and LT plots."""
