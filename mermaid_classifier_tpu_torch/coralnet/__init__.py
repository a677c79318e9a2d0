"""CoralNet ETL integration: the per-point training-manifest builder."""
