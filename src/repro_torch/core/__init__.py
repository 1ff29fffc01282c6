"""The port's data path: warehouse, DWRF, reader, decode and transform
engines, and the DPP session."""
