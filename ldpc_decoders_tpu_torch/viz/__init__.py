"""Analysis of simulation results: result plots and their batch cases,
parity-polytope demos, ensemble averages and LT plots."""
