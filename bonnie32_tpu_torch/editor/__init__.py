"""World-editor state: tools, selection, undo/redo, clipboards.
(The port's own copy of the JAX package's `editor/__init__.py`, host code.)

Host-side editor bookkeeping mirroring
the reference's `src/editor/state.rs` (EditorTool :126, Selection :188,
clipboards :221-307, undo events :930-1093).
"""

from .state import (CopiedFace, EditorState, EditorTool, FaceClipboard,
                    GeometryClipboard, GridViewMode, SectorFace, Selection,
                    SelectionSnapshot, TriangleSelection, UndoEvent)

__all__ = ["EditorState", "EditorTool", "GridViewMode", "TriangleSelection",
           "SectorFace", "Selection", "SelectionSnapshot", "FaceClipboard",
           "CopiedFace", "GeometryClipboard", "UndoEvent"]
