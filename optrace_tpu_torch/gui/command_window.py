"""Command window: a scriptable REPL around TraceGUI.run_command with
history (counterpart of ``optrace_tpu/gui/command_window.py``; behavioral
parity with reference ``optrace/gui/command_window.py:12``,
which renders the same state into a traitsui/Qt dialog; here the state is
plain attributes so tests and batch scripts drive it headlessly).
"""

from ..utils.property_checker import PropertyChecker as pc


class CommandWindow:

    def __init__(self, gui) -> None:
        """:param gui: parent TraceGUI"""
        self.gui = gui
        self.cmd: str = ""                #: command to run
        self.history: list = []           #: command history
        self.automatic_replot: bool = True
        #: clipboard stand-in: copy_history writes here (headless backend)
        self.clipboard: str = ""

    def send_command(self, cmd: str = None) -> None:
        """Execute ``cmd`` (or the stored ``self.cmd``) in the GUI scope and
        append it to the history if it differs from the last entry
        (reference command_window.py:120-133)."""
        if cmd is not None:
            pc.check_type("cmd", cmd, str)
            self.cmd = cmd
        if self.cmd:
            self.gui.run_command(self.cmd, automatic_replot=self.automatic_replot)
            if not self.history or self.cmd != self.history[-1]:
                self.history = self.history + [self.cmd]

    def clear_history(self) -> None:
        self.history = []

    def copy_history(self) -> str:
        """Join the history into the clipboard stand-in and return it
        (reference copies to the Qt clipboard, command_window.py:94-110)."""
        self.clipboard = "".join(el + "\n" for el in self.history)
        return self.clipboard

    def replot(self) -> None:
        """Replot/retrace button (reference command_window.py:112-118)."""
        self.gui.replot()
