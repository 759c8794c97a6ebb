"""Prose-drift guard: every feature claim in docs/claims_manifest.json
still appears in its doc and names a pinning test that still exists."""

import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _manifest():
    return json.loads((ROOT / "docs" / "claims_manifest.json").read_text())


def test_prose_claims_are_pinned():
    """Every feature claim in the manifest must (a) still appear verbatim in its doc — if the feature
    claim is reworded/removed, the manifest must follow — and (b) name a
    pinning test function that still exists, so the claim cannot outlive
    its evidence."""
    problems = []
    for entry in _manifest()["claims"]:
        doc = ROOT / entry["doc"]
        if not doc.exists():
            problems.append(f"doc missing: {entry['doc']}")
            continue
        if entry["claim"] not in doc.read_text():
            problems.append(
                f"claim text not found in {entry['doc']}: {entry['claim']!r}"
            )
        test_file, _, test_fn = entry["test"].partition("::")
        tf = ROOT / test_file
        if not tf.exists():
            problems.append(f"pinning test file missing: {test_file}")
        elif f"def {test_fn.split('[')[0]}(" not in tf.read_text():
            problems.append(f"pinning test gone: {entry['test']}")
    assert not problems, "prose claims drifted:\n" + "\n".join(problems)


def test_manifest_covers_key_claims():
    """The manifest must keep pinning the claims that drifted in past
    rounds (one-compile S-matrix) — deleting the entry instead of the
    claim would re-open the channel."""
    tests_pinned = {e["test"] for e in _manifest()["claims"]}
    assert any("test_s_matrix_is_one_compile" in t for t in tests_pinned)
