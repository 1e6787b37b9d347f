"""The PyTorch package's ``trainModel`` and ``countHitTranscripts`` entry
points against the JAX package's, on the same small inputs (CPU): the
same model file, the same transcript-hit table."""

import json

from crackling_tpu.utils import cli as jax_cli
from crackling_tpu_torch.pipeline import transcripts
from crackling_tpu_torch.sgrnascorer import default_training_data
from crackling_tpu_torch.utils import cli


def test_train_model_matches_jax(tmp_path):
    good, bad = default_training_data()
    (tmp_path / "good.txt").write_text("\n".join(good[:80]) + "\n")
    (tmp_path / "bad.txt").write_text("\n".join(bad[:80]) + "\n")
    models = {}
    for name, main in (("jax", jax_cli.main_train_model),
                       ("torch", cli.main_train_model)):
        out = tmp_path / f"{name}.json"
        main(["-g", str(tmp_path / "good.txt"), "-b",
              str(tmp_path / "bad.txt"), "-o", str(out)])
        models[name] = json.loads(out.read_text())
    assert len(models["torch"]["weights"]) == 80
    assert models["torch"] == models["jax"]


def test_count_hit_transcripts_matches_jax(tmp_path):
    crk = tmp_path / "guides.csv"
    crk.write_text(transcripts.SAMPLE_CRACKLING)
    tables = {}
    for name, main in (("jax", jax_cli.main_count_hit_transcripts),
                       ("torch", cli.main_count_hit_transcripts)):
        # one annotation file each: each package parses its own (the
        # parse is cached in a pickle beside the file)
        gff = tmp_path / f"{name}.gff"
        gff.write_text(transcripts.SAMPLE_ANNOTATION)
        out = tmp_path / f"{name}.csv"
        main(["-a", str(gff), "-c", str(crk), "-o", str(out)])
        tables[name] = out.read_text()
    rows = tables["torch"].splitlines()
    assert rows[0].endswith("hits") and len(rows) == 5
    assert tables["torch"] == tables["jax"]
