// CBAS-TPU desktop shell.
//
// Electron wrapper that owns the Python backend's lifecycle, mirroring the
// reference shell's contract (reference: main.js:22-55,87,168-195):
//   1. spawn the backend (python -m cbas_tpu_torch.app.main)
//   2. scrape its stdout for "Eel server starting on http://localhost:<port>"
//   3. load that URL into the window
//   4. take the whole process tree down with the window
//
// The backend prints that exact line whether it is serving Eel or the plain
// JSON-RPC/SSE server, so this shell works against either mode.

const { app, BrowserWindow, dialog, ipcMain } = require('electron');
const { spawn } = require('child_process');
const path = require('path');

const READY_RE = /Eel server starting on (http:\/\/localhost:\d+)/;
const BACKEND_ARGS = ['-m', 'cbas_tpu_torch.app.main', '--port', '0'];

let pythonProc = null;
let mainWindow = null;
let quitting = false;

// Single instance: two backends would race on the same project tree and
// recorder processes (reference main.js:10-20). A second launch focuses the
// existing window instead. The whenReady wiring lives INSIDE the winning
// branch: a losing instance must never reach startBackend even if 'ready'
// fires before its queued quit is processed.
if (!app.requestSingleInstanceLock()) {
  app.quit();
} else {
  app.on('second-instance', () => {
    if (mainWindow) {
      if (mainWindow.isMinimized()) mainWindow.restore();
      mainWindow.focus();
    }
  });
  app.whenReady().then(() => {
    createWindow();
    startBackend((url) => {
      if (mainWindow) mainWindow.loadURL(url);
    });
  });
}

function pythonExecutable() {
  // Prefer a sibling venv (like the reference's hardcoded venv path, but
  // discovered rather than assumed); fall back to PATH.
  const repoRoot = path.join(__dirname, '..', '..');
  const candidates = process.platform === 'win32'
    ? [path.join(repoRoot, 'venv', 'Scripts', 'python.exe')]
    : [path.join(repoRoot, 'venv', 'bin', 'python')];
  for (const c of candidates) {
    try { require('fs').accessSync(c); return c; } catch (_) {}
  }
  return process.platform === 'win32' ? 'python' : 'python3';
}

function startBackend(onReady) {
  pythonProc = spawn(pythonExecutable(), BACKEND_ARGS, {
    cwd: path.join(__dirname, '..', '..'),
    env: { ...process.env, PYTHONUNBUFFERED: '1' },
    // Own process group on POSIX so stopBackend() can signal the whole tree
    // (backend + its ffmpeg recorder children) via kill(-pgid).
    detached: process.platform !== 'win32',
  });

  let readyFired = false;
  pythonProc.stdout.on('data', (data) => {
    const text = data.toString();
    process.stdout.write(`[backend] ${text}`);
    const m = text.match(READY_RE);
    if (m && !readyFired) {
      readyFired = true;
      onReady(m[1]);
    }
  });
  pythonProc.stderr.on('data', (d) => process.stderr.write(`[backend] ${d}`));
  // A failed spawn (no venv, no python on PATH) emits 'error', not 'exit';
  // without this handler the EventEmitter throws and crashes the shell.
  pythonProc.on('error', (err) => {
    pythonProc = null;
    if (!quitting) {
      dialog.showErrorBox(
        'CBAS backend failed to start',
        `Could not launch the Python backend (${err.message}). ` +
        'Install Python 3 or create a venv/ next to the repo, then restart.'
      );
      app.quit();
    }
  });
  pythonProc.on('exit', (code) => {
    pythonProc = null;
    if (!quitting) {
      dialog.showErrorBox(
        'CBAS backend exited',
        `The Python backend stopped unexpectedly (code ${code}). ` +
        'Check the terminal output, then restart the app.'
      );
      app.quit();
    }
  });
}

function stopBackend() {
  if (!pythonProc) return;
  // Kill the whole tree: the backend may own ffmpeg recorder children.
  if (process.platform === 'win32') {
    spawn('taskkill', ['/pid', String(pythonProc.pid), '/f', '/t']);
  } else {
    try { process.kill(-pythonProc.pid, 'SIGTERM'); } catch (_) {
      try { pythonProc.kill('SIGTERM'); } catch (_) {}
    }
  }
  pythonProc = null;
}

function createWindow() {
  mainWindow = new BrowserWindow({
    width: 1400,
    height: 900,
    show: false,
    webPreferences: {
      preload: path.join(__dirname, 'preload.js'),
      contextIsolation: true,
      nodeIntegration: false,
    },
  });
  mainWindow.loadFile(path.join(__dirname, 'splash.html'));
  mainWindow.once('ready-to-show', () => mainWindow.show());
  mainWindow.on('closed', () => { mainWindow = null; });
}

// Native file dialogs for the frontend (reference main.js:108-159).
ipcMain.handle('dialog:openDirectory', async () => {
  const r = await dialog.showOpenDialog(mainWindow, { properties: ['openDirectory'] });
  return r.canceled ? null : r.filePaths[0];
});
ipcMain.handle('dialog:openFiles', async (_e, filters) => {
  const r = await dialog.showOpenDialog(mainWindow, {
    properties: ['openFile', 'multiSelections'],
    filters: filters || [{ name: 'Videos', extensions: ['mp4', 'avi', 'mov', 'mkv'] }],
  });
  return r.canceled ? [] : r.filePaths;
});
ipcMain.handle('dialog:saveFile', async (_e, defaultName) => {
  const r = await dialog.showSaveDialog(mainWindow, { defaultPath: defaultName });
  return r.canceled ? null : r.filePath;
});
// Renderer-supplied contents to a user-chosen path (reference
// save-file-to-disk, main.js:131-139): used for exporting generated CSVs.
ipcMain.handle('dialog:saveData', async (_e, defaultName, data) => {
  const r = await dialog.showSaveDialog(mainWindow, { defaultPath: defaultName });
  if (r.canceled || !r.filePath) return null;
  try {
    require('fs').writeFileSync(r.filePath, data);
    return r.filePath;
  } catch (err) {
    dialog.showErrorBox('Save Error', 'Could not save the file: ' + err.message);
    return null;
  }
});

app.on('before-quit', () => { quitting = true; stopBackend(); });
app.on('window-all-closed', () => app.quit());
