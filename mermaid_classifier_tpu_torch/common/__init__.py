"""Shared utilities of the PyTorch port: tables, CSV specs, the sqlite ETL
engine and the MERMAID taxonomy. Stdlib only (parquet through pyarrow,
imported inside the one function that reads it)."""
