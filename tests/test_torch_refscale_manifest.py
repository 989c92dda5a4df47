"""The port's regeneration of the reference-scale corpus against its manifest.

``regen_refscale.generate`` with the manifest's generator parameters, into a
temporary directory, through the port's pandas-free pipeline: every one of
the seven sha256 that ``data_refscale/MANIFEST.json`` records (the split
CSVs, split_info.json, the graph's CSV, npz and stats) must match. Equality
of bytes, no tolerance. 1.4 M events; about a minute on one CPU core.
"""

import json

import torch

from gat_recommendation_torch.scripts.data import regen_refscale

torch.set_num_threads(1)


def test_regeneration_reproduces_every_manifest_sha256(tmp_path):
    manifest = json.loads(regen_refscale.MANIFEST.read_text())
    seconds = regen_refscale.generate(manifest["generator_params"], tmp_path)
    assert list(seconds) == ["generate", "sessionize", "split", "graph"]
    assert len(manifest["files"]) == 7
    assert regen_refscale.check(manifest, tmp_path) == []
    assert json.loads((tmp_path / "processed" / "split_info.json").read_text())["num_items"] == 466_864
    # The command line's --check reads the same files and agrees.
    assert regen_refscale.main(["--check", "--data-dir", str(tmp_path)]) == 0
