"""Shared SARIF 2.1.0 plumbing for the repo's static-analysis tools.

graftlint (``tools/lint``, AST-level) reports through the schema the JAX
package's analyzers use, with the same rule ids, so CI can upload a
single merged ``analysis.sarif`` artifact and reviewers get one
annotation stream. Each tool supplies its rule registry (name ->
doc/family) and its findings; ``merge_sarif`` concatenates per-tool runs
into one document (the SARIF shape for multi-tool results — one ``runs``
entry per driver).
"""

from __future__ import annotations

__all__ = ["build_sarif_doc", "merge_sarif", "merge_sarif_files"]

SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def _result(f, suppressed: bool) -> dict:
    res = {
        "ruleId": f.rule,
        "level": "error",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path.replace("\\", "/")},
                "region": {"startLine": int(f.line),
                           "startColumn": int(f.col) + 1},
            },
        }],
    }
    if suppressed:
        res["suppressions"] = [{"kind": "inSource",
                                "justification": "reasoned inline "
                                                 "suppression"}]
    return res


def build_sarif_doc(tool_name: str, rule_docs: dict, family_of,
                    findings, suppressed) -> dict:
    """One-run SARIF document for one tool.

    Args:
      tool_name: ``tool.driver.name`` (``graftlint``).
      rule_docs: rule name -> docstring (first line becomes the short
        description).
      family_of: rule name -> family string (driver rule property).
      findings: active findings (``rule``/``path``/``line``/``col``/
        ``message`` attributes — both tools' Finding shapes qualify).
      suppressed: findings silenced by a reasoned waiver/suppression.
    """
    rules = [
        {
            "id": name,
            "shortDescription": {
                "text": (doc.splitlines()[0] if doc else name)},
            "fullDescription": {"text": doc},
            "properties": {"family": family_of(name)},
        }
        for name, doc in rule_docs.items()
    ]
    results = [_result(f, False) for f in findings]
    results += [_result(f, True) for f in suppressed]
    return {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": tool_name,
                "informationUri":
                    "https://github.com/quiver-tpu/quiver-tpu",
                "rules": rules,
            }},
            "results": results,
        }],
    }


def merge_sarif(docs) -> dict:
    """Concatenate the ``runs`` of several SARIF documents into one."""
    runs = []
    for doc in docs:
        runs.extend(doc.get("runs", []))
    return {"$schema": SARIF_SCHEMA, "version": "2.1.0", "runs": runs}


def merge_sarif_files(in_paths, out_path) -> None:
    """CLI-facing merge: ``python -c "from quiver_tpu_torch.tools.sarif
    import merge_sarif_files; merge_sarif_files(['lint.sarif',
    'other.sarif'], 'analysis.sarif')"``. Missing inputs are skipped so a partially
    failed CI matrix still uploads what it has."""
    import json
    import os

    docs = []
    for p in in_paths:
        if os.path.exists(p):
            with open(p) as fh:
                docs.append(json.load(fh))
    # atomic publish: the merged artifact is uploaded/read by other steps,
    # so a crash mid-write must leave an invisible temp, never a torn file
    tmp_path = out_path + ".tmp"
    with open(tmp_path, "w") as fh:
        json.dump(merge_sarif(docs), fh, indent=2)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp_path, out_path)
