"""One module per kind of traffic; a traffic mix's ``kind`` names it. Each
has ``run(ctx) -> harness.result.Outcome``."""
