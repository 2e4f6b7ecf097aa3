"""Workflow node library (ComfyUI-compatible op surface).  Importing
``ops.basic`` and ``ops.distributed`` registers their ops; the workflow
parser does so."""
