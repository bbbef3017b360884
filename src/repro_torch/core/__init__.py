"""The write and read paths of the port: decompose, align, lossless,
refactor (plain and fused) and progressive retrieval."""
