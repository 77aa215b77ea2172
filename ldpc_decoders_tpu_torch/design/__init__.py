"""Code design: BEC density evolution, threshold solving, optimal
irregular degree distributions and ensemble generation
(reference src/ldpc.py; counterpart of ``ldpc_decoders_tpu.design``)."""

from ldpc_decoders_tpu_torch.design.density_evolution import (  # noqa: F401
    Dist,
    de_step,
    gen_rand_irg_ldpc,
    get_node_dist,
    rate_from_polys,
    reg_pol,
    solve_dist,
    solve_eps_bp,
)
