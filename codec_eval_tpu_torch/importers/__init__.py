"""CSV import of external benchmark results (a copy of ``codec_eval_tpu/importers``).
"""

from .csv_import import CsvImporter, CsvSchema, CsvSchemaBuilder, ExternalResult

__all__ = ["CsvImporter", "CsvSchema", "CsvSchemaBuilder", "ExternalResult"]
