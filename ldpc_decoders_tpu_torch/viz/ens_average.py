"""Ensemble-average result files (counterpart of
``ldpc_decoders_tpu.viz.ens_average``; no torch needed).

The reference ships unindexed ensemble summaries alongside the member
results (data/output/<channel>-<prefix>-<decoder>.json, e.g.
bec-1200_3_6_rand_ldpc-SPA.json): the pointwise mean of the members'
wer/ber curves plus the member list, in the schema

    {channel, prefix, decoder, sources: [code names, string-sorted],
     wer: {param: mean}, ber: {param: mean}}

Its plot layer recomputes the same mean at plot time (graph.py:63-72
``comp_average``); the committed summary files are the persisted form.
This module regenerates them from the members' Saver files, as the JAX
package's does, to the same bytes.

Usage:
    python -m ldpc_decoders_tpu_torch.viz.ens_average bec \
        1200_3_6_rand_ldpc SPA --data_dir artifacts/data
"""

from __future__ import annotations

import json
import os
import re


def member_files(data_dir: str, channel: str, prefix: str,
                 decoder: str) -> dict:
    """{member code name -> artifact path} for every member result file
    ``<channel>-<prefix>_<i>-<decoder>-...`` in ``data_dir``."""
    pat = re.compile(
        rf"^{re.escape(channel)}-({re.escape(prefix)}_\d+)-"
        rf"{re.escape(decoder)}(-|\.json$)")
    out = {}
    for fn in os.listdir(data_dir):
        m = pat.match(fn)
        if m:
            out[m.group(1)] = os.path.join(data_dir, fn)
    return out


def comp_average(curves: list) -> dict:
    """Pointwise mean over the curves' shared-and-unique params
    (reference graph.py:63-72: every member holding the param
    contributes)."""
    pot = {}
    for curve in curves:
        for param, val in curve.items():
            pot.setdefault(param, []).append(val)
    return {param: sum(v) / float(len(v)) for param, v in pot.items()}


def dump_average(data_dir: str, channel: str, prefix: str, decoder: str,
                 out_dir: str | None = None) -> str:
    """Write ``<channel>-<prefix>-<decoder>.json`` (reference schema)
    from the member artifacts present in ``data_dir``; returns the
    path."""
    members = member_files(data_dir, channel, prefix, decoder)
    if not members:
        raise FileNotFoundError(
            f"no member artifacts {channel}-{prefix}_*-{decoder} "
            f"in {data_dir}")
    sources = sorted(members)            # string sort, like the reference
    data = {}
    for name in sources:
        with open(members[name]) as fp:
            data[name] = json.load(fp)
    summary = {
        "channel": channel,
        "prefix": prefix,
        "decoder": decoder,
        "sources": sources,
        "wer": comp_average([data[n].get("wer", {}) for n in sources]),
        "ber": comp_average([data[n].get("ber", {}) for n in sources]),
    }
    out_dir = out_dir or data_dir
    path = os.path.join(out_dir, f"{channel}-{prefix}-{decoder}.json")
    with open(path, "w") as fp:
        json.dump(summary, fp, indent=4)
    return path


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Write reference-schema ensemble-average JSONs")
    p.add_argument("channel")
    p.add_argument("prefix")
    p.add_argument("decoder", nargs="+")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", default=None)
    args = p.parse_args(argv)
    for dec in args.decoder:
        path = dump_average(args.data_dir, args.channel, args.prefix, dec,
                            args.out_dir)
        print(path)


if __name__ == "__main__":
    main()
