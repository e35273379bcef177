"""Homepage HTML (GET /) — endpoint directory + config upload form.

A copy of the JAX package's ``service/homepage.py``, byte for byte in what
it renders, so both services answer ``GET /`` alike; of the operations
it lists, ``rematch`` is served by the JAX package only until the port's
rematch module lands (its capture is ``torch.profiler``'s, though the
text names ``jax.profiler``).

Serves the role of the reference's Jinjava template
(src/main/resources/templates/index.html, rendered at App.java:653-660):
lists every workload's endpoints and offers the config upload form.  The
reference's label bug (SURVEY.md quirk Q4: recordlinkage link *text* rendered
with the wrong variable) is fixed here.
"""

from __future__ import annotations

from html import escape


def render_homepage(app) -> str:
    rows = []

    def link(href: str) -> str:
        return f'<a href="{escape(href)}">{escape(href)}</a>'

    rows.append("<h2>Deduplications</h2>")
    if not app.deduplications:
        rows.append("<p><i>none configured</i></p>")
    for name, wl in sorted(app.deduplications.items()):
        rows.append(f"<h3>{escape(name)}</h3><ul>")
        rows.append(f"<li>GET {link(f'/deduplication/{name}')} &mdash; incremental link feed (?since=N)</li>")
        for dataset_id in sorted(wl.datasources):
            rows.append(
                f"<li>POST {link(f'/deduplication/{name}/{dataset_id}')} &mdash; ingest+match a JSON batch</li>"
            )
            rows.append(
                f"<li>POST {link(f'/deduplication/{name}/{dataset_id}/httptransform')} &mdash; side-effect-free transform</li>"
            )
        rows.append("</ul>")

    rows.append("<h2>Record linkages</h2>")
    if not app.record_linkages:
        rows.append("<p><i>none configured</i></p>")
    for name, wl in sorted(app.record_linkages.items()):
        rows.append(f"<h3>{escape(name)}</h3><ul>")
        rows.append(f"<li>GET {link(f'/recordlinkage/{name}')} &mdash; incremental link feed (?since=N)</li>")
        for dataset_id in sorted(wl.datasources):
            rows.append(
                f"<li>POST {link(f'/recordlinkage/{name}/{dataset_id}')} &mdash; ingest+match a JSON batch</li>"
            )
            rows.append(
                f"<li>POST {link(f'/recordlinkage/{name}/{dataset_id}/httptransform')} &mdash; side-effect-free transform</li>"
            )
        rows.append("</ul>")

    rows.append("<h2>Operations</h2><ul>")
    rows.append(
        f"<li>GET {link('/healthz')} &mdash; liveness probe "
        "(alias: /health)</li>"
    )
    rows.append(
        f"<li>GET {link('/readyz')} &mdash; readiness probe (config, "
        "workloads, device backend)</li>"
    )
    rows.append(
        f"<li>GET {link('/metrics')} &mdash; Prometheus metrics "
        "(HTTP, engine phases, corpus, JIT)</li>"
    )
    rows.append(
        f"<li>GET {link('/stats')} &mdash; per-workload counters "
        "(records, batches, pairs, timings)</li>"
    )
    rows.append(
        "<li>POST /{deduplication|recordlinkage}/:name/rematch &mdash; "
        "ring bulk re-match / link-DB backfill (device backends)</li>"
    )
    rows.append(
        f"<li>GET {link('/debug/traces')} &mdash; flight recorder "
        "(retained traces; /debug/traces/&lt;id&gt;?format=chrome for "
        "Perfetto)</li>"
    )
    rows.append(
        f"<li>GET {link('/debug/requests')} &mdash; last-N request "
        "digests with per-phase timings</li>"
    )
    rows.append(
        "<li>POST /debug/profile?seconds=N &mdash; on-demand "
        "jax.profiler device capture</li>"
    )
    rows.append("</ul>")

    body = "\n".join(rows)
    return f"""<!DOCTYPE html>
<html>
<head><title>Duke microservice (TPU)</title></head>
<body>
<h1>Duke record-matching microservice &mdash; TPU-native</h1>
<p>The active configuration is served at <a href="/config">/config</a>.</p>
{body}
<h2>Upload new configuration</h2>
<form method="post" action="/config" enctype="multipart/form-data">
  <input type="file" name="configfile"/>
  <input type="submit" value="Upload"/>
</form>
</body>
</html>
"""
